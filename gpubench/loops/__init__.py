"""The loops that traffic mixes drive, one module a loop, named by a
mix's ``loop`` key."""
