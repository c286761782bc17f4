"""Small helpers shared by the renderer and its drivers."""
