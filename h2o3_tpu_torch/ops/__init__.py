"""Device operators of the port: the histogram kernel and feature binning."""
