"""The chip's peaks and the operation and byte counts of the program's
kernels and calls, computed from shapes (`peaks`, `counts`)."""
