"""Distributed layer: document-axis sharding over a jax.sharding.Mesh.

The reference is single-process NumPy (SURVEY §5.8 — no distributed
backend exists there). Here corpus scale-out is first-class: the doc-major
term table is sharded over the mesh 'd' axis, queries are replicated,
per-shard scoring + local top-k run under shard_map, and the global merge
and corpus statistics ride lax collectives between devices.
"""
