// Fixed-point re-quantization (DAIS opcode +/-3, TRN/WRAP): o = wrap(+/-a << SHIFT)
// with SHIFT = f_out - f_in (negative SHIFT is an arithmetic right shift).
module quantizer #(
    parameter WA = 8,
    parameter SA = 1,
    parameter NEG = 0,
    parameter SHIFT = 0,
    parameter WO = 8
) (
    input  [WA-1:0] a,
    output [WO-1:0] o
);
    localparam SHL = SHIFT > 0 ? SHIFT : 0;
    localparam SHR = SHIFT < 0 ? -SHIFT : 0;
    localparam WI = (WA > WO + SHR ? WA : WO + SHR) + SHL + 1;
    wire signed [WI-1:0] ea = SA ? $signed(a) : $signed({1'b0, a});
    wire signed [WI-1:0] v = NEG ? -ea : ea;
    wire signed [WI-1:0] shifted = (v <<< SHL) >>> SHR;
    assign o = shifted[WO-1:0];
endmodule
