"""Launch layer: the LLM trainer and server (the mesh, dry-run and roofline
tools are the second half of ROADMAP.md queue 1 item 8d)."""
