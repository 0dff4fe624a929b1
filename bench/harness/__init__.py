"""The benchmark's harness: cell discovery, traffic, weights, the timed
drivers, trace reading and the correctness checks.  It imports the
program under test (``repro_torch``) and nothing of the JAX package."""
