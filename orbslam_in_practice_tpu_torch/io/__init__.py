"""Input and output: synthetic sequences, dataset loaders, the native frame loader, trajectories, ATE."""
