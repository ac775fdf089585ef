"""The paper's experiments on the PyTorch/CUDA port: Fig. 2, 3b and 4 and
Table 3a, one module each, as `benchmarks/` runs them on the JAX package.

    PYTHONPATH=src python -m benchmarks_torch.run [--quick] [--device cpu]
"""
