"""The feed-forward method registry (the part evaluation needs)."""
