"""Losses: masked map losses and ADD(-S) pose losses (KRRN)."""
