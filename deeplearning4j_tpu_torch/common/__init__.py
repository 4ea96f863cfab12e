"""Host-side helpers of the port: device resolution, shape buckets, the
``TDL_*`` environment flags, dtypes and the mixed-precision policy."""
