"""Communication layer of the port: the flat wire layout and headers
(`flat`), the stream compressors (`compressors`), the downlink replicas
(`downlink`) and the exact byte accounting (`accounting`)."""
