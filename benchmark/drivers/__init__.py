"""The benchmark's entries into the port: one module per entry, named
by a configuration's ``entry``. Each has ``run(cell, seed, seconds,
trace, device)`` → the run's record, and nothing in them branches on a
cell's name: a cell's differences live in its configuration and traffic
files."""
