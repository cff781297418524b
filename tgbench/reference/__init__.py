"""The plain reference: CTR-GCN with the TAM offset branch in plain PyTorch
(`model`), the skeleton graphs (`graphs`), the two feeders' transforms and
the loader's order (`feeders`) and the SGD recipe (`sgd`). It imports
nothing of the program under test and takes nothing the program made."""
