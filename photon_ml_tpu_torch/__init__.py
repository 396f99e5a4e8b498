"""PyTorch/CUDA port of photon_ml_tpu: GLM regularization sweeps and GAME
(GLMix) training on an NVIDIA GPU, with hand-written CUDA kernels for the
fused GLM value+gradient (one, M or E coefficient rows at a time) and the
Hessian-vector product of TRON; the CLIs around them, batch and online
scoring with ranked retrieval, the model-quality layer (training
diagnostics, quality baselines, the canary and the drift monitor),
multi-process training and scoring over ``torch.distributed``, one process
a card (``parallel/``, ``game/multiprocess.py``, the fleet supervisor), and
one process over a mesh of several slots (``parallel/mesh.py``,
``train_game --mesh``).

Runs on ``cuda`` by default; pass ``device="cpu"`` to run on the CPU (the
kernels' plain PyTorch versions). The JAX package ``photon_ml_tpu`` stays
the reference; this package imports nothing of it.
"""

#: the JAX package's version, which this port tracks
__version__ = "0.1.0"
