"""ScenePredNet in PyTorch and its weight bridge from the flax checkpoint."""
