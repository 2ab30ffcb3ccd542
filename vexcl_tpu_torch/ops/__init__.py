"""Algorithm layer: the Reductor and its map-reduce kernel, stencils."""
