"""The benchmark's plain reference: flow, reductions and signal chain in
plain PyTorch and NumPy. It imports nothing of the program under test and
takes nothing that the program made."""
