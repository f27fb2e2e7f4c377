"""Sharding helpers of the port: logical-axis rules (`sharding`) and the
collectives' byte accounting (`comm_stats`)."""
