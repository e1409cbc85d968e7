"""Single-device BFS: expansion backends, traversal policies, the level
loop and the Graph500 validator."""
