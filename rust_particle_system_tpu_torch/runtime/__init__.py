"""Host-loop driver, validators and the CLI."""
