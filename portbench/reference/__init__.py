"""Plain float32 PyTorch references for the comparison that decides
`correct`.  Nothing here imports the system under test."""
