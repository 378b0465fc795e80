"""Static kernel tiling from the card's budgets."""
