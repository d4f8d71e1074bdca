"""NN+C-driven schedule autotuning (``tuner``): the port of the JAX
package's ``autotune``."""
