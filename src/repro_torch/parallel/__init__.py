"""Mesh context, logical-axis sharding rules and the local SPMD pieces
(collectives and shard ranges) the mesh path runs on."""
