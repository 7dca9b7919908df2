"""jpgenc_tpu — a baseline-JPEG encode/decode engine on JAX accelerators.

Built from scratch in JAX/XLA/Pallas with the capability envelope of the
reference project Nuos/jpgEnc (see SURVEY.md). Public API lives in
`jpgenc_tpu.api`: `encode`, `decode`, `encode_batch`.
"""

__version__ = "0.1.0"
