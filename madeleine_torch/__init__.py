"""MADELEINE on PyTorch and CUDA (NVIDIA Hopper).

The port of `madeleine_tpu` to PyTorch. Module names follow the JAX package
so each counterpart is easy to find; the serving and extraction path
(`models.madeleine.encode` -> `models.abmil.abmil_embed`) runs two
hand-written CUDA kernels, `ops.encode_fused` (bf16) and `ops.gated_pool`
(f32). Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
