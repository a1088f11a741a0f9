"""Operations, bytes and least times of the measured functions."""
