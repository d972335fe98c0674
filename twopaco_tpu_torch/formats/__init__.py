"""Text output formats of the junction list."""
