"""PyTorch/CUDA port of photon_ml_tpu: GLM regularization sweeps and GAME
(GLMix) training on an NVIDIA GPU, with hand-written CUDA kernels for the
fused GLM value+gradient (one, M or E coefficient rows at a time) and the
Hessian-vector product of TRON.

Runs on ``cuda`` by default; pass ``device="cpu"`` to run on the CPU (the
kernels' plain PyTorch versions). The JAX package ``photon_ml_tpu`` stays
the reference; this package imports nothing of it.
"""
