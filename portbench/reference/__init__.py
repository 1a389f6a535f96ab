"""The plain float32 reference of the benchmark's cells."""
