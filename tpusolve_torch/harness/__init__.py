"""Run orchestration: LinearSystem lifecycle, golden check, CLI."""
