"""The benchmark's own machinery: finding a cell's pieces by name, running a
cell, reading the profiler's trace, judging correctness, the card's peaks."""
