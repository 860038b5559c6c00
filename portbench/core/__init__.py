"""The harness: cell lookup, the measured window's arithmetic, the
roofline and MFU yardstick, the trace reader and the benchmark's weights."""
