"""The plain reference that decides a run's ``correct``: plain torch and
numpy, frozen copies of the port's plain paths. It imports nothing of the
port and nothing of JAX."""
