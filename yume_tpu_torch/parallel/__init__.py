"""Sequence-parallel serving: process groups, Ulysses / ring / USP
attention and the sharded DiT forward."""
