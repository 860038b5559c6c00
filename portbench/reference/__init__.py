"""The plain reference: torch operations on the benchmark's own inputs and
weights, in float32 with TF32 off, imports nothing of the port and takes
nothing it made. `precision.Rounding` puts the same code a precision step
lower, which is the control each cell has to fail."""
