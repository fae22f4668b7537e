"""Device compute path (JAX/XLA).

This package replaces the reference's CUDA kernel suite
(/root/reference/vision-gpu/cuda/cuda.cu) with jitted XLA programs:

  * pipeline.py — ONE fused jitted pass per frame resolution producing every
    intermediate the host needs (the reference launches 6+ kernels over 4
    streams and re-reads the same pixels several times; XLA fuses the whole
    elementwise DAG into a single sweep over device memory).
  * lsd.py      — the 3600-ray longest-line search as a dense, chunked,
    fully-vectorized scan (the reference launches a CUDA kernel per seed with
    a nondeterministic atomicCAS reduction; here every ray is a lane and the
    reduction is a deterministic argmax).
  * hsv.py      — float32 HSV + marker classifier matching the numpy oracle.
  * scales_device.py — the on-device scale reader (glyphs + bar scan).
"""
