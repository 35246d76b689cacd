"""Launch layer: the LLM trainer and server, and the mesh, dry-run and
roofline tools."""
