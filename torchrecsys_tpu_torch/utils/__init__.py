"""Checkpoints, weight carry-over from the JAX package, the Feistel
permutation, logging, profiling and the trace reader."""
