"""Demo scenes of the port."""
