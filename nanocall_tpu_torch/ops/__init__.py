"""Device ops of the port: the grouped Viterbi decode and its CUDA kernels."""
