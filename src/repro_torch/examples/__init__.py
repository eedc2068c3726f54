"""The port's twins of the JAX package's examples (``examples/``): each
runs on the card unless ``--device cpu`` asks for the CPU."""
