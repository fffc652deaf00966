# Hand-written Hopper kernels, one subpackage per Pallas kernel family of the
# JAX package.  Sources live in each subpackage's ``csrc/``; ``build`` compiles
# them with nvcc on first use.
