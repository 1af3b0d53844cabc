"""The port's CUDA kernels, each behind an engine-facing wrapper."""


def launch_counters() -> dict:
    """Each kernel wrapper by name; its ``launches`` attribute counts the
    kernel launches made through it."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_chunk_attention import ops as pca
    from repro_torch.kernels.pq_scan import ops as pq
    return {"paged_decode_attention": pa.paged_decode_attention,
            "pq_scan": pq.pq_scan, "decode_attention": da.decode_attention,
            "flash_attention": fa.flash_attention,
            "decode_attention_partial": da.decode_attention_partial,
            "paged_chunk_attention": pca.paged_chunk_attention}
