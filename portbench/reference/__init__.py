"""The plain float64 reference the benchmark judges the port against."""
