"""The port's benchmark harness: manifest, inputs from the seed, generators, window,
trace reduction and the yardstick's counts."""
