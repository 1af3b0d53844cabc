"""Plain float32 reference of the served model, the encoder and exact kNN.

Written from the configurations in ``bench/configs/``: GQA with partial
interleaved RoPE, SwiGLU, RMSNorm, a bidirectional mean-pooled encoder,
cosine kNN with ties to the lower index.  It imports nothing of the
program (``repro_torch``), of the JAX package or of JAX, and calls no
kernel: only ``torch`` operations in float32 with TF32 off.  It takes the
weights and inputs the benchmark made and works out everything else
(database embeddings, caches) again.
"""
