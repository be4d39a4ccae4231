"""Reference tiering engines, one file per engine name."""
