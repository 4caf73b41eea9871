"""Model builders of the port (this slice: GBM on the histogram tree engine)."""
