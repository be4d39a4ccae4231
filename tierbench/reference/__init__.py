"""The plain numpy reference that decides whether a run is correct."""
