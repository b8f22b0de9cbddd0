"""The yardstick's arithmetic: the work a model part's function needs (its
multiply-adds, its other elementwise operations, and the bytes of its own
inputs, outputs and weights, each counted once), and the card's peaks."""
