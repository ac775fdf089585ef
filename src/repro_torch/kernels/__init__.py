"""Hand-written Hopper kernels of the routing and serving paths, their
plain PyTorch versions (`ref`), and the dispatch wrappers (`ops`)."""
