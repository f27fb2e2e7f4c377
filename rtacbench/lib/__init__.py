"""The harness's shared pieces: finding a cell's files, the traced slice, the
byte bound, instance pools, the control and the result line."""
