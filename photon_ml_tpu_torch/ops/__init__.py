"""GLM math: losses, designs, normalization, regularization, the objective
and its fused CUDA kernels."""
