"""Each arch's mapping onto the program's model config, one module an
arch (``<arch>.py``, found by `portbench.cells.Bench.program`): its
``program_config(d, conf)`` imports the program inside the function."""
