"""Policy-gradient algorithms of the port."""
