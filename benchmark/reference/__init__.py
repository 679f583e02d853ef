"""The plain reference that decides `correct`: float32 PyTorch written from
the published descriptions, sharing no code and no weights with the program
under test."""
