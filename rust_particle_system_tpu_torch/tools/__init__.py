"""Tools that check the toolchain and the card (run on a card)."""
