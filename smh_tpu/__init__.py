"""smh_tpu — a rebuild of Squad Mortar Helper's vision stack in JAX.

The reference (WilliamVenner/squad-mortar-helper) is a Rust+CUDA desktop
assistant; this framework re-designs its capabilities around JAX/XLA:

  * smh_tpu.ops       — JAX/XLA compute path (fused per-frame pipeline,
                        batched ray-march LSD) replacing the CUDA kernels
  * smh_tpu.vision    — backend contract, numpy oracle, pipeline driver
  * smh_tpu.parallel  — mesh-sharded batch-of-frames pipeline (multi-chip)
  * smh_tpu.ocr       — Tesseract C-API binding fed by device-preprocessed crops
  * smh_tpu.squadex   — ballistics, heightmaps (SMHHM), firing solutions
  * smh_tpu.heightmaps— heightmap-ripper subprocess contract + test stub
  * smh_tpu.web       — asyncio server speaking the reference's binary
                        WebSocket protocol + a fresh browser client
  * smh_tpu.native    — C++ host hot loops (seed scan, minimap march, ...)
"""

__version__ = "0.1.0"
