"""See the package docstring of benchmark.reference.gsw."""
