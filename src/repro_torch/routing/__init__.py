"""The paper's baseline routers (KNN, MLP, SVM)."""
