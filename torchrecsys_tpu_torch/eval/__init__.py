"""Full-catalog top-k and ranking metrics."""
