"""The benchmark's harness: what every cell shares."""
