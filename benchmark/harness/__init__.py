"""The general code of the benchmark: nothing in it names a cell."""
