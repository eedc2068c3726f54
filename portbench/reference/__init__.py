"""The plain float32 references the benchmark holds the program against,
one module an arch (``<arch>.py``, found by `portbench.cells.Bench.arch`),
and what they share (`layers`, `inits`, the federated round `fed`); it
imports nothing of the program."""
