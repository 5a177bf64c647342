"""Signature-level INDArray parity accounting: the port's own copy of
``deeplearning4j_tpu/ndarray/parity.py``'s signature table.

Reference: ``org.nd4j.linalg.api.ndarray.INDArray`` (~700 method
signatures) and the ``Nd4j`` factory. Java overloads collapse into
methods with optional arguments (``add(INDArray)``, ``add(INDArray,
INDArray result)`` and ``add(Number)`` are all ``add``), so the unit is
the signature: every row maps one reference signature to the method that
covers it, and ``coverage()`` checks the mapping against the port's live
``NDArray`` (``nd4j_coverage()`` against its ``Nd4j``). The rows are the
reference's, unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Entry = Tuple[str, str]  # (java signature, python method name)


def _sigs() -> Dict[str, List[Entry]]:
    fam: Dict[str, List[Entry]] = {}

    # ------------------------------------------------ arithmetic binops
    # each op: (INDArray), (INDArray, INDArray result), (Number),
    # (Number, INDArray result) — all collapse onto one python method
    arith = ["add", "sub", "mul", "div", "rsub", "rdiv",
             "addi", "subi", "muli", "divi", "rsubi", "rdivi"]
    fam["arithmetic"] = [
        (f"{op}({a})", op) for op in arith
        for a in ("INDArray", "INDArray, INDArray", "Number",
                  "Number, INDArray")]
    fam["modulo"] = [
        (f"{op}({a})", op) for op in ("fmod", "fmodi", "remainder",
                                      "remainderi")
        for a in ("INDArray", "Number")]
    fam["neg"] = [("neg()", "neg"), ("negi()", "negi")]

    # ------------------------------------------- broadcast vector binops
    vec = ["add", "addi", "sub", "subi", "mul", "muli", "div", "divi",
           "rdiv", "rdivi", "rsub", "rsubi"]
    fam["row_col_vector"] = (
        [(f"{op}RowVector(INDArray)", f"{op}RowVector") for op in vec]
        + [(f"{op}ColumnVector(INDArray)", f"{op}ColumnVector")
           for op in vec]
        + [("putRowVector(INDArray)", "putiRowVector"),
           ("putColumnVector(INDArray)", "putiColumnVector"),
           ("putiRowVector(INDArray)", "putiRowVector"),
           ("putiColumnVector(INDArray)", "putiColumnVector")])

    # ---------------------------------------------------- comparisons
    comp = ["lt", "lte", "gt", "gte", "eq", "neq"]
    fam["comparison"] = (
        [(f"{op}({a})", op) for op in comp for a in ("INDArray", "Number")]
        + [(f"{op}i({a})", f"{op}i") for op in comp
           for a in ("INDArray", "Number")]
        + [("eps(INDArray)", "eps"), ("eps(Number)", "eps"),
           ("and(INDArray)", "and_"), ("or(INDArray)", "or_"),
           ("xor(INDArray)", "xor_"), ("not()", "not_"),
           ("isNaN()", "isNaN"), ("isInfinite()", "isInfinite")])

    # ---------------------------------------------------- reductions
    # sum-like: (int... dim), (boolean keepDims, int... dim),
    # (INDArray result, int... dim) → one python method with kwargs
    red3 = ["sum", "mean", "max", "min", "prod", "norm1", "norm2",
            "normmax", "std", "var", "amax", "amin", "amean", "asum",
            "cumsum", "cumprod", "argMax", "argMin", "entropy",
            "shannonEntropy", "logEntropy"]
    fam["reductions"] = [
        (f"{op}({a})", op) for op in red3
        for a in ("int... dim", "boolean, int... dim")]
    fam["reductions"] += [
        ("sum(INDArray result, int... dim)", "sum"),
        ("mean(INDArray result, int... dim)", "mean"),
        ("median(int... dim)", "median"),
        ("percentile(Number, int... dim)", "percentile"),
        ("cumsumi(int dim)", "cumsumi"),
        ("cumprodi(int dim)", "cumprodi"),
    ]
    fam["reduction_numbers"] = [
        (f"{op}Number()", f"{op}Number") for op in
        ("sum", "mean", "max", "min", "prod", "std", "var", "norm1",
         "norm2", "normmax", "amax", "amin", "amean", "asum", "median",
         "percentile", "entropy", "shannonEntropy", "logEntropy")]
    fam["reduction_numbers"] += [
        ("sumLong()", "sumLong"), ("prodLong()", "prodLong"),
        ("stdNumber(boolean)", "stdNumber"),
        ("varNumber(boolean)", "varNumber")]
    fam["along_dimension"] = [
        (f"{op}AlongDimension(int...)", f"{op}AlongDimension") for op in
        ("max", "min", "prod", "std", "var", "norm1", "norm2", "normmax",
         "sum", "mean")]
    fam["along_dimension"] += [
        ("cumsumAlongDimension(int)", "cumsumAlongDimension"),
        ("norm1NumberAlong(int...)", "norm1NumberAlong"),
        ("norm2NumberAlong(int...)", "norm2NumberAlong"),
        ("normmaxNumberAlong(int...)", "normmaxNumberAlong")]
    fam["index_reductions"] = [
        ("maxIndex()", "maxIndex"), ("minIndex()", "minIndex"),
        ("argSort()", "argSort"),
        ("sort(int dim, boolean asc)", "sortAlongDimension"),
        ("sortWithIndices(int, boolean)", "sortWithIndices")]
    fam["distances"] = [
        ("distance1(INDArray)", "distance1"),
        ("distance2(INDArray)", "distance2"),
        ("squaredDistance(INDArray)", "squaredDistance")]
    fam["boolean_reductions"] = [
        ("all()", "all"), ("any()", "any"), ("none()", "none"),
        ("countNonZero()", "countNonZero"), ("countZero()", "countZero")]

    # ------------------------------------------------------- linalg
    fam["linalg"] = [
        ("mmul(INDArray)", "mmul"),
        ("mmul(INDArray, INDArray result)", "mmul"),
        ("mmul(INDArray, MMulTranspose)", "mmul"),
        ("mmuli(INDArray)", "mmuli"),
        ("mmuli(INDArray, INDArray result)", "mmuli"),
        ("mmuli(INDArray, MMulTranspose)", "mmuli"),
        ("dot(INDArray)", "dot"),
        ("tensorMmul(INDArray, int[][])", "tensorMmul")]

    # ------------------------------------------------- scalar accessors
    fam["scalar_get"] = [
        ("getDouble(long)", "getDouble"),
        ("getDouble(long, long)", "getDouble"),
        ("getDouble(long...)", "getDouble"),
        ("getFloat(long)", "getFloat"),
        ("getFloat(long, long)", "getFloat"),
        ("getFloat(long...)", "getFloat"),
        ("getInt(int...)", "getInt"),
        ("getLong(long)", "getLong"), ("getLong(long...)", "getLong"),
        ("getNumber(long...)", "getNumber"),
        ("getDoubleUnsafe(long)", "getDoubleUnsafe"),
        ("getScalar(long)", "getScalar"),
        ("getScalar(long...)", "getScalar"),
        ("getString(long)", "getString"),
        ("element()", "element"), ("item()", "item")]
    fam["scalar_put"] = [
        (f"putScalar({a})", "putScalar") for a in
        ("long, double", "long, float", "long, int", "long[], double",
         "long[], float", "long[], int", "int[], double",
         "long, long, double", "long, long, long, double")]
    fam["scalar_put"] += [
        ("putScalarUnsafe(long, double)", "putScalarUnsafe")]

    # ------------------------------------------------ get/put structure
    fam["get_put"] = [
        ("get(INDArrayIndex...)", "get"),
        ("get(INDArray indices)", "get"),
        ("put(INDArrayIndex[], INDArray)", "put"),
        ("put(INDArrayIndex[], Number)", "put"),
        ("put(int, int, Number)", "put"),
        ("put(int[], INDArray)", "put"),
        ("getRow(long)", "getRow"), ("getRow(long, boolean dup)", "getRow"),
        ("getColumn(long)", "getColumn"),
        ("getColumn(long, boolean dup)", "getColumn"),
        ("getRows(int...)", "getRows"),
        ("getColumns(int...)", "getColumns"),
        ("putRow(long, INDArray)", "putRow"),
        ("putColumn(int, INDArray)", "putColumn"),
        ("putSlice(int, INDArray)", "putSlice"),
        ("slice(long)", "slice_"), ("slice(long, int)", "slice_"),
        ("slices()", "slices"),
        ("subArray(long[], int[], int[])", "subArray"),
        ("getWhere(INDArray, Condition)", "getWhere"),
        ("getWhere(Number, Condition)", "getWhere"),
        ("putWhere(INDArray, INDArray, Condition)", "putWhere"),
        ("putWhere(Number, INDArray, Condition)", "putWhere"),
        ("putWhere(Number, Number, Condition)", "putWhere"),
        ("putWhereWithMask(INDArray, INDArray)", "putWhereWithMask"),
        ("putWhereWithMask(INDArray, Number)", "putWhereWithMask"),
        ("replaceWhere(INDArray, Condition)", "replaceWhere"),
        ("replaceWhere(Number, Condition)", "replaceWhere"),
        ("match(INDArray, Condition)", "match"),
        ("match(Number, Condition)", "match"),
        ("scan(Condition)", "scan"),
        ("assign(INDArray)", "assign"), ("assign(Number)", "assign"),
        ("assign(boolean)", "assign"),
        ("assignIf(INDArray, Condition)", "assignIf")]

    # --------------------------------------------------- shape structure
    fam["shape_structure"] = [
        ("reshape(long...)", "reshape"),
        ("reshape(char order, long...)", "reshape"),
        ("reshape(int[])", "reshape"),
        ("ravel()", "ravel"), ("ravel(char order)", "ravel"),
        ("flatten()", "flatten"),
        ("transpose()", "transpose"), ("transposei()", "transposei"),
        ("permute(int...)", "permute"), ("permutei(int...)", "permutei"),
        ("swapAxes(int, int)", "swapAxes"),
        ("dimShuffle(Object[], long[], boolean[])", "dimShuffle"),
        ("broadcast(long...)", "broadcast"),
        ("broadcast(INDArray result)", "broadcast"),
        ("broadcastTo(long...)", "broadcastTo"),
        ("expandDims(int)", "expandDims"),
        ("squeeze()", "squeeze"), ("squeeze(int)", "squeeze"),
        ("repeat(int, long...)", "repeat"),
        ("repmat(int...)", "repmat"),
        ("tile(int...)", "tile"),
        ("tensorAlongDimension(long, int...)", "tensorAlongDimension"),
        ("javaTensorAlongDimension(long, int...)",
         "javaTensorAlongDimension"),
        ("tensorsAlongDimension(int...)", "tensorsAlongDimension"),
        ("tensorssAlongDimension(int...)", "tensorssAlongDimension"),
        ("vectorAlongDimension(int, int)", "vectorAlongDimension"),
        ("vectorsAlongDimension(int)", "vectorsAlongDimension"),
        ("sliceVectors(List<INDArray>)", "sliceVectors")]

    # ------------------------------------------------------- duplication
    fam["dup"] = [
        ("dup()", "dup"), ("dup(char order)", "dup"),
        ("ulike()", "ulike"), ("like()", "like"),
        ("unsafeDuplication()", "unsafeDuplication"),
        ("unsafeDuplication(boolean)", "unsafeDuplication"),
        ("migrate()", "migrate"), ("migrate(boolean)", "migrate"),
        ("leverage()", "leverage"), ("leverageTo(String)", "leverageTo"),
        ("leverageTo(String, boolean)", "leverageTo"),
        ("leverageOrDetach(String)", "leverageOrDetach"),
        ("detach()", "detach")]

    # ------------------------------------------------------ conversions
    fam["conversions"] = [
        (f"to{k}{f}()", f"to{k}{f}") for k in
        ("Double", "Float", "Int", "Long") for f in ("Vector", "Matrix")]
    fam["conversions"] += [
        ("toBoolVector()", "toBoolVector"), ("toBoolMatrix()",
                                             "toBoolMatrix"),
        ("castTo(DataType)", "castTo"),
        ("convertToFloats()", "convertToFloats"),
        ("convertToDoubles()", "convertToDoubles"),
        ("convertToHalfs()", "convertToHalfs"),
        ("toDense()", "toDense"),
        ("toString(long, boolean, int)", "toStringFull"),
        ("toStringFull()", "toStringFull")]

    # ------------------------------------------------------- predicates
    fam["predicates"] = [
        (f"{p}()", p) for p in
        ("isScalar", "isVector", "isMatrix", "isSquare", "isRowVector",
         "isColumnVector", "isRowVectorOrScalar", "isColumnVectorOrScalar",
         "isEmpty", "isSparse", "isCompressed", "isAttached", "isView",
         "isWrapAround", "isR", "isZ", "isB", "isS", "closeable",
         "wasClosed", "close")]
    fam["predicates"] += [
        ("equals(Object)", "equals"),
        ("equalsWithEps(Object, double)", "equalsWithEps"),
        ("equalShapes(INDArray)", "equalShapes")]

    # ------------------------------------------------------ shape meta
    fam["shape_meta"] = [
        ("shape()", "shape"), ("rank()", "rank"), ("length()", "length"),
        ("lengthLong()", "lengthLong"), ("size(int)", "size"),
        ("rows()", "rows"), ("columns()", "columns"),
        ("stride()", "stride"), ("stride(int)", "stride"),
        ("offset()", "offset"), ("originalOffset()", "originalOffset"),
        ("ordering()", "ordering"),
        ("elementWiseStride()", "elementWiseStride"),
        ("majorStride()", "majorStride"),
        ("secondaryStride()", "secondaryStride"),
        ("innerMostStride()", "innerMostStride"),
        ("linearView()", "linearView"),
        ("linearViewColumnOrder()", "linearViewColumnOrder"),
        ("resetLinearView()", "resetLinearView"),
        ("linearIndex(int)", "linearIndex"),
        ("shapeInfo()", "shapeInfo"),
        ("shapeInfoDataBuffer()", "shapeInfoDataBuffer"),
        ("shapeInfoJava()", "shapeInfoJava"),
        ("jvmShapeInfo()", "jvmShapeInfo"),
        ("shapeDescriptor()", "shapeDescriptor"),
        ("shapeInfoToString()", "shapeInfoToString"),
        ("getTrailingOnes()", "getTrailingOnes"),
        ("getLeadingOnes()", "getLeadingOnes"),
        ("underlyingRank()", "underlyingRank"),
        ("dataType()", "dataType"), ("data()", "data"),
        ("checkDimensions(INDArray)", "checkDimensions"),
        ("setShapeAndStride(int[], int[])", "setShapeAndStride"),
        ("setOrder(char)", "setOrder"),
        ("markAsCompressed(boolean)", "markAsCompressed")]

    # ---------------------------------------------------- sparse protocol
    fam["sparse"] = [
        ("nnz()", "nnz"),
        ("getVectorCoordinates()", "getVectorCoordinates"),
        ("sparseInfoDataBuffer()", "sparseInfoDataBuffer")]

    # --------------------------------------- tranche 5 (surface5.py)
    fam["condition_serial"] = [
        ("cond(Condition)", "cond"), ("condi(Condition)", "condi"),
        ("toFlatArray(FlatBufferBuilder)", "toFlatArray"),
        ("isInScope()", "isInScope"),
        ("epsi(INDArray)", "epsi"), ("epsi(Number)", "epsi"),
        ("setShape(long...)", "setShape"),
        ("setStride(long...)", "setStride"),
        ("setData(DataBuffer)", "setData")]
    return fam


SIGNATURES: Dict[str, List[Entry]] = _sigs()

#: Signatures intentionally NOT mapped (the reference's divergences): the
#: physical layout is not settable, there are no workspaces. The mapped
#: setShapeAndStride/setOrder entries above exist and raise with the
#: divergence message — matching how BaseNDArray itself throws for
#: unsupported forms — so they count as surface, not silence.
KNOWN_GAPS: List[str] = [
    "data().pointer()/DataBuffer internals (no JavaCPP buffer objects)",
    "workspace-scoped leverage variants beyond the no-op contract",
]


def _nd4j_sigs() -> Dict[str, List[Entry]]:
    """``Nd4j`` factory statics (ref: org.nd4j.linalg.factory.Nd4j, ~7k
    lines). Same counting rule as the INDArray manifest: one row per Java
    overload signature, mapped to the python static that covers it."""
    fam: Dict[str, List[Entry]] = {}

    fam["create"] = (
        [(f"create({a})", "create") for a in
         ("int...", "long...", "float[]", "double[]", "float[][]",
          "double[][]", "float[], int[]", "double[], int[]",
          "float[], int[], char", "double[], long[], char",
          "float[], long[], long[], char, DataType",
          "DataType, long...", "List<INDArray>, int[]")]
        + [("createFromArray(float...)", "createFromArray"),
           ("createFromArray(double...)", "createFromArray"),
           ("createFromArray(int...)", "createFromArray"),
           ("createUninitialized(long...)", "createUninitialized"),
           ("createUninitialized(DataType, long...)", "createUninitialized"),
           ("createUninitializedDetached(DataType, char, long...)",
            "createUninitializedDetached"),
           ("empty()", "empty"), ("empty(DataType)", "empty"),
           ("emptyLike(INDArray)", "emptyLike"),
           ("scalar(double)", "scalar"), ("scalar(float)", "scalar"),
           ("scalar(int)", "scalar"), ("scalar(DataType, Number)", "scalar"),
           ("trueScalar(Number)", "trueScalar"),
           ("trueVector(double[])", "trueVector"),
           ("valueArrayOf(long[], double)", "valueArrayOf"),
           ("valueArrayOf(long, long, double)", "valueArrayOf"),
           ("full(long[], Number)", "full")])
    fam["zeros_ones"] = (
        [(f"zeros({a})", "zeros") for a in
         ("int...", "long...", "DataType, long...", "int, int")]
        + [(f"ones({a})", "ones") for a in
           ("int...", "long...", "DataType, long...", "int, int")]
        + [("zerosLike(INDArray)", "zerosLike"),
           ("onesLike(INDArray)", "onesLike")])
    fam["ranges"] = [
        ("linspace(long, long, long)", "linspace"),
        ("linspace(DataType, long, long, long)", "linspace"),
        ("linspace(double, double, long, DataType)", "linspace"),
        ("logspace(double, double, long)", "logspace"),
        ("arange(double)", "arange"), ("arange(double, double)", "arange"),
        ("eye(long)", "eye"), ("meshgrid(INDArray...)", "meshgrid"),
        ("vander(INDArray)", "vander"), ("tri(int, int, int)", "tri"),
        ("triu(INDArray, int)", "triu"), ("tril(INDArray, int)", "tril"),
        ("diag(INDArray)", "diag"), ("diag(INDArray, int)", "diag")]
    fam["random_factory"] = [
        ("rand(int, int)", "rand"), ("rand(int...)", "rand"),
        ("rand(long...)", "rand"), ("rand(DataType, long...)", "rand"),
        ("rand(char, long...)", "rand"),
        ("randn(int, int)", "randn"), ("randn(int...)", "randn"),
        ("randn(long...)", "randn"), ("randn(DataType, long...)", "randn"),
        ("randint(int, long...)", "randint"),
        ("randUniform(double, double, long...)", "randUniform"),
        ("randomBernoulli(double, long...)", "randomBernoulli"),
        ("randomBernoulli(double, INDArray)", "randomBernoulli"),
        ("randomBinomial(int, double, long...)", "randomBinomial"),
        ("randomExponential(double, long...)", "randomExponential"),
        ("randomGamma(double, double, long...)", "randomGamma"),
        ("randomPoisson(double, long...)", "randomPoisson"),
        ("choice(INDArray, INDArray, int)", "choice"),
        ("shuffle(INDArray, int...)", "shuffle"),
        ("getRandom()", "getRandom"),
        ("getRandomFactory()", "getRandomFactory")]
    fam["combine_split"] = [
        ("concat(int, INDArray...)", "concat"),
        ("specialConcat(int, INDArray...)", "specialConcat"),
        ("hstack(INDArray...)", "hstack"), ("vstack(INDArray...)", "vstack"),
        ("stack(int, INDArray...)", "stack"),
        ("pile(INDArray...)", "pile"), ("tear(INDArray, int...)", "tear"),
        ("split(INDArray, int, int)", "split"),
        ("repeat(INDArray, int)", "repeat"),
        ("tile(INDArray, int...)", "tile"),
        ("pad(INDArray, int[][])", "pad"),
        ("pad(INDArray, int[][], Nd4j.PadMode)", "pad"),
        ("append(INDArray, int, double, int)", "pad"),   # value-pad along axis
        ("appendBias(INDArray...)", "appendBias"),
        ("expandDims(INDArray, int)", "expandDims"),
        ("squeeze(INDArray, int)", "squeeze"),
        ("stripOnes(INDArray)", "stripOnes")]
    fam["structure"] = [
        ("reverse(INDArray)", "reverse"), ("flip(INDArray, int...)", "flip"),
        ("fliplr(INDArray)", "fliplr"), ("flipud(INDArray)", "flipud"),
        ("rot90(INDArray)", "rot90"), ("roll(INDArray, int)", "roll"),
        ("roll(INDArray, int, int...)", "roll"),
        ("rollAxis(INDArray, int)", "rollAxis"),
        ("rollAxis(INDArray, int, int)", "rollAxis"),
        ("where(INDArray, INDArray, INDArray)", "where"),
        ("gather(INDArray, INDArray, int)", "gather"),
        ("scatterUpdate(...)", "scatterUpdate"),
        ("isMax(INDArray)", "isMax"), ("isMax(INDArray, int...)", "isMax"),
        ("sort(INDArray, boolean)", "sort"),
        ("sort(INDArray, int, boolean)", "sort"),
        ("sortRows(INDArray, int, boolean)", "sortRows"),
        ("sortColumns(INDArray, int, boolean)", "sortColumns"),
        ("sortWithIndices(INDArray, int, boolean)", "sortWithIndices"),
        ("shape(INDArray)", "shape"), ("getStrides(long[])", "getStrides"),
        ("getStrides(long[], char)", "getStrides"),
        ("checkShapeValues(long[])", "checkShapeValues"),
        ("toFlattened(INDArray...)", "toFlattened"),
        ("toFlattened(char, INDArray...)", "toFlattened"),
        ("unique(INDArray)", "unique"), ("nonzero(INDArray)", "nonzero"),
        ("histogram(INDArray, int)", "histogram")]
    fam["linalg_statics"] = [
        ("gemm(INDArray, INDArray, boolean, boolean)", "gemm"),
        ("gemm(INDArray, INDArray, INDArray, boolean, boolean, double, "
         "double)", "gemm"),
        ("matmul(INDArray, INDArray)", "matmul"),
        ("matmul(INDArray, INDArray, INDArray)", "matmul"),
        ("matmul(INDArray, INDArray, boolean, boolean, boolean)", "matmul"),
        ("dot(INDArray, INDArray)", "dot"),
        ("tensorMmul(INDArray, INDArray, int[][])", "tensorMmul"),
        ("kron(INDArray, INDArray)", "kron"),
        ("outer(INDArray, INDArray)", "outer"),
        ("cholesky(INDArray)", "cholesky"), ("qr(INDArray)", "qr"),
        ("svd(INDArray)", "svd"), ("lu(INDArray)", "lu"),
        ("eig(INDArray)", "eig"), ("lstsq(INDArray, INDArray)", "lstsq"),
        ("solve(INDArray, INDArray)", "solve"), ("inv(INDArray)", "inv"),
        ("pinv(INDArray)", "pinv"), ("det(INDArray)", "det"),
        ("matrixRank(INDArray)", "matrixRank"),
        ("getBlasWrapper()", "getBlasWrapper")]
    fam["reduction_statics"] = [
        (f"{op}(INDArray{d})", op) for op in
        ("max", "min", "mean", "sum", "prod", "std", "var", "norm1",
         "norm2", "normmax", "cumsum", "cumprod", "argMax", "argMin")
        for d in ("", ", int...")]
    fam["reduction_statics"] += [
        ("average(INDArray[])", "average"),
        ("averageAndPropagate(INDArray[])", "averageAndPropagate"),
        ("accumulate(INDArray...)", "accumulate"),
        ("accumulate(INDArray, Collection<INDArray>)", "accumulate"),
        ("bilinearProducts(INDArray, INDArray)", "bilinearProducts"),
        ("clearNans(INDArray)", "clearNans")]
    fam["io_statics"] = [
        ("read(DataInputStream)", "read"),
        ("readBinary(File)", "readBinary"),
        ("readNumpy(String)", "readNumpy"),
        ("readNumpy(String, String)", "readNumpy"),
        ("readTxt(String)", "readTxt"),
        ("write(INDArray, DataOutputStream)", "write"),
        ("writeTxt(INDArray, String)", "writeTxt"),
        ("writeAsNumpy(INDArray, File)", "writeAsNumpy"),
        ("writeNumpy(INDArray, String)", "writeNumpy"),
        ("saveBinary(INDArray, File)", "saveBinary"),
        ("fromByteArray(byte[])", "fromByteArray"),
        ("toByteArray(INDArray)", "toByteArray"),
        ("fromNumpy(numpy)", "fromNumpy"),
        ("createFromNpyFile(File)", "createFromNpyFile"),
        ("createFromNpzFile(File)", "createFromNpzFile"),
        ("createNpyFromByteArray(byte[])", "createNpyFromByteArray"),
        ("toNpyByteArray(INDArray)", "toNpyByteArray"),
        ("createFromData(DataBuffer, long...)", "createFromData")]
    fam["env_statics"] = [
        ("dataType()", "dataType"),
        ("setDefaultDataType(DataType)", "setDefaultDataType"),
        ("setDefaultDataTypes(DataType, DataType)", "setDefaultDataTypes"),
        ("defaultFloatingPointType()", "defaultFloatingPointType"),
        ("getExecutioner()", "getExecutioner"),
        ("getBackend()", "getBackend"), ("backend()", "backend"),
        ("getEnvironment()", "getEnvironment"),
        ("getMemoryManager()", "getMemoryManager"),
        ("getAffinityManager()", "getAffinityManager"),
        ("getCompressor()", "getCompressor"),
        ("factory()", "factory"), ("order()", "order"),
        ("sizeOfDataType(DataType)", "sizeOfDataType"),
        ("exec(Op)", "exec_"), ("exec(CustomOp)", "exec_"),
        ("setSeed(long)", "setSeed"), ("version()", "version")]
    # ------------------------------------------ tranche 6 (probed tail)
    fam["buffers_runtime"] = [
        ("getDataType()", "getDataType"),
        ("setDataType(DataType)", "setDataType"),
        ("typeConversion(INDArray, DataTypeEx)", "typeConversion"),
        ("batchMmul(INDArray[], INDArray[])", "batchMmul"),
        ("batchMmul(INDArray[], INDArray[], boolean, boolean)",
         "batchMmul"),
        ("createBuffer(long)", "createBuffer"),
        ("createBuffer(float[])", "createBuffer"),
        ("createBuffer(double[], DataType)", "createBuffer"),
        ("createArrayFromShapeBuffer(DataBuffer, DataBuffer)",
         "createArrayFromShapeBuffer"),
        ("versionCheck()", "versionCheck"),
        ("getDeallocatorService()", "getDeallocatorService"),
        ("getShapeInfoProvider()", "getShapeInfoProvider")]
    return fam


ND4J_SIGNATURES: Dict[str, List[Entry]] = _nd4j_sigs()


def nd4j_coverage(strict: bool = True):
    """Machine-check the Nd4j manifest against the live factory class
    (same callable-or-property rule as the INDArray check)."""
    from deeplearning4j_tpu_torch.ndarray.factory import Nd4j
    return coverage(cls=Nd4j, strict=strict, manifest=ND4J_SIGNATURES)


def coverage(cls=None, strict: bool = True, manifest=None):
    """Machine-check a manifest against a live class (default: the
    INDArray manifest against NDArray).

    Returns (covered:int, total:int, missing:[(family, sig, py)]).
    """
    if cls is None:
        from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray as cls
    if manifest is None:
        manifest = SIGNATURES
    covered, total, missing = 0, 0, []
    for family, entries in manifest.items():
        for sig, py in entries:
            total += 1
            attr = getattr(cls, py, None)
            if attr is None or not (callable(attr)
                                    or isinstance(attr, property)):
                missing.append((family, sig, py))
            else:
                covered += 1
    if strict and missing:
        raise AssertionError(f"unmapped signatures: {missing}")
    return covered, total, missing


def distinct_method_count() -> int:
    """Distinct REFERENCE method names covered (unique python targets in the
    manifest — python-only helpers like ``toNumpy``/``buf`` don't count)."""
    return len({py for entries in SIGNATURES.values() for _, py in entries})
