"""Plain float32 PyTorch references of the configurations the benchmark
runs. Nothing here imports the program, JAX or the JAX package."""
