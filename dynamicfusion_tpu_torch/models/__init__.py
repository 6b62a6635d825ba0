"""State containers: the TSDF volume and the warp field."""
