"""Host-side target assignment of the LiDAR track (numpy)."""
