"""The plain reference of the benchmark: MLS-MPM on bucket arrays and the
default SSFR frame, in plain PyTorch. It imports nothing of the program
and takes its parameters from the configuration files alone."""
