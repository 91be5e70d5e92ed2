"""Plain references of models the port serves beyond the JAX package: plain torch, no
kernels, for the tests to hold the port against."""
