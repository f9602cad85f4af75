"""Platform policy and the build of the CUDA kernels."""
