"""Config, device resolution and seeded generators."""
