"""Optimisation: pose-only, bundle adjustment and the Sim3 pose graph."""
