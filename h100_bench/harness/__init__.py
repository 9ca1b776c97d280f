"""The benchmark's own machinery: the manifest and the files it names,
the scenes and the weights made from the seed, the profiler's reading,
the operation and byte counts, the peaks, and the comparison with the
plain reference that decides ``correct``."""
