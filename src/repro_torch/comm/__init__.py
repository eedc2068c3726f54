"""Communication layer of the port: the flat wire layout and the direct
path's byte accounting (compressors, downlink and headers come with the
comm slice)."""
