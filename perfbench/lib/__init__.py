"""The benchmark's yardstick: generators, peaks and counts, the plain
reference, the comparison and the trace's reduction. Nothing here imports
the program."""
