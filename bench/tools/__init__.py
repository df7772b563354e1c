"""Tools run beside the benchmark (not by its runs)."""
