"""Persistence of the port: so far only the grid's canonical combo key."""
