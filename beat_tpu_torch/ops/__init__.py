"""Device ops of the port: (re, im) pair helpers and kernel wrappers."""
