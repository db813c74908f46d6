"""Host-side parallel helpers of the port (collapse's dispatch fuser)."""
