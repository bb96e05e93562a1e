"""Host-side helpers of the port (numpy and PIL only)."""
