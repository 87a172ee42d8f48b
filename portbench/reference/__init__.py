"""The plain reference of each configuration (``<config>.py``: its data
and its log density with the density's gradient), the method's plain
pieces (`vi`, `psis`) and the protocols that work a timed call's results
out again from its seed (`protocols`).  Nothing here imports the
program."""
