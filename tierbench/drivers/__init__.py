"""Drivers of the system under test, one file per kind of cell (the
configuration file names its driver)."""
