"""Launch entry points: `launch.serve` (the serving CLI, render and LM
modes) and `launch.mesh` (the one-device mesh)."""
