"""The benchmark's yardstick: inputs made from the seed, the ops and bytes
of each configuration, the reading of the profiler's trace, the checks and
the result line.  Nothing here imports the measured program, except
`graph.check_graph`, which reads the program's layer graph to hold it
against the configuration's table."""
