"""Losses: masked map losses, ADD(-S) pose losses (KRRN) and the
transparent pipeline's confidence ADD(-S) and completion losses."""
