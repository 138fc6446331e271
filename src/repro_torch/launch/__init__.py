"""Launch entry points: `launch.serve` (the serving CLI, render and LM
modes), `launch.train` (the LM training CLI), `launch.steps` (the train,
prefill and decode step builders) and `launch.mesh` (the one-device
mesh)."""
