// o = ((a' << SHA) +/- (b' << SHB)) >>> GSHIFT, truncated to WO bits.
// a'/b' are sign- (SA/SB=1) or zero-extended operands. Arithmetic matches the
// DAIS shift-add semantics (da4ml_tpu/runtime/numpy_backend.py, opcode 0/1):
// low WO bits are exact under two's-complement wrap.
module shift_adder #(
    parameter WA = 8,
    parameter SA = 1,
    parameter WB = 8,
    parameter SB = 1,
    parameter SHA = 0,
    parameter SHB = 0,
    parameter SUB = 0,
    parameter GSHIFT = 0,
    parameter WO = 8
) (
    input  [WA-1:0] a,
    input  [WB-1:0] b,
    output [WO-1:0] o
);
    // internal width: enough for both shifted operands, the carry, and the
    // bits consumed by the final arithmetic right shift
    localparam WSA = WA + SHA + 1;
    localparam WSB = WB + SHB + 1;
    localparam WMX = WSA > WSB ? WSA : WSB;
    localparam WI  = (WMX > WO + GSHIFT ? WMX : WO + GSHIFT) + 1;

    wire signed [WI-1:0] ea = SA ? $signed(a) : $signed({1'b0, a});
    wire signed [WI-1:0] eb = SB ? $signed(b) : $signed({1'b0, b});
    wire signed [WI-1:0] sum = SUB ? (ea <<< SHA) - (eb <<< SHB) : (ea <<< SHA) + (eb <<< SHB);
    wire signed [WI-1:0] shifted = sum >>> GSHIFT;
    assign o = shifted[WO-1:0];
endmodule
