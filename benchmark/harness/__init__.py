"""The benchmark harness: manifest, the kinds' shared base and draws,
the program's entry points, trace reduction, checks."""
