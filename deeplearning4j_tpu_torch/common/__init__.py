"""Host-side helpers of the port (device resolution, shape bucketing)."""
