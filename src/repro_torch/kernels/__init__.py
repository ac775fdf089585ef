"""Hand-written Hopper kernels of the routing path, their plain PyTorch
versions (`ref`), and the dispatch wrappers (`ops`)."""
