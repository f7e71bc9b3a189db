"""What every cell shares: the window, the profiles, the roofline
arithmetic, the seeded weights and inputs, and the files of the cells."""
