"""Setup math (Bessel, Matern kernel matrices, linear algebra) and the
hand-written CUDA kernels of the sampler target (manifold.py)."""
