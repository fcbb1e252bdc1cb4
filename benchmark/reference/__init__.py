"""The plain fp32 PyTorch reference that decides `correct`: it imports
nothing of the program under test and takes nothing the program made."""
