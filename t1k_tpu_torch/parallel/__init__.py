"""Multi-process execution of the port's pipeline driver."""
